"""The (data, model) device mesh for data- and tensor-parallel execution
(port of `parallel/mesh.py`).

JAX runs the mesh through GSPMD in one process; here one process is one
rank (torchrun), the mesh is a `torch.distributed.DeviceMesh` of shape
(n_data, n_model) with dims ("data", "model"), and the collectives are
written out: the ranks of one model group hold different heads of the
same rows and all-reduce after every row-parallel product, so their
activations, logits and every host decision (argmax, sampler, beam
pruning, early stop) agree bit for bit; the data groups hold different
rows and meet only to gather results. No pipeline, sequence or expert
parallelism, for JAX's reasons (every Whisper size fits one card).
"""

from __future__ import annotations

import contextlib
import contextvars
import pickle
from typing import Any, Callable, List, NamedTuple, Optional

import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"


class PartitionSpec(tuple):
    """The port's `jax.sharding.PartitionSpec`: one mesh axis name (or
    None) per tensor dimension; trailing dimensions left out are
    unsharded."""

    def __new__(cls, *axes: Optional[str]):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def make_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """A (data, model) DeviceMesh over the initialised world
    (`distributed.initialize_distributed` first). n_data defaults to
    world // n_model. Rank r sits at (r // n_model, r % n_model), so a
    model group is n_model consecutive ranks (one host's cards)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the process group: call "
            "parallel.initialize_distributed() under torchrun first")
    n = dist.get_world_size()
    if n % n_model != 0:
        raise ValueError(f"{n} ranks not divisible by n_model={n_model}")
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} ranks")
    # the mesh only names groups here (no DTensor): "cuda" under NCCL, "cpu"
    # under gloo, whose ranks may share one card
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(AXIS_DATA, AXIS_MODEL))


def launch_mesh(n_model: int, flag: str,
                command: str = "openai_whisper_coreml_tpu_torch f.wav"):
    """The (world / n_model, n_model) mesh of a torchrun launch, joining
    the process group first (the entry points' `flag`, e.g.
    --tensor-parallel); raises outside a launch, saying how to start one
    (`command`: the entry point's module and arguments)."""
    from .distributed import initialize_distributed, launched_ranks

    if launched_ranks() == 1:
        raise RuntimeError(
            f"{flag} {n_model} runs one process per rank: launch with "
            f"torchrun --nproc-per-node W (W a multiple of {n_model}), e.g. "
            f"torchrun --nproc-per-node {n_model} -m {command} {flag} {n_model}")
    initialize_distributed()
    return make_mesh(n_model=n_model)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


class ModelAxis(NamedTuple):
    """What a tensor-parallel module needs: the model group, this rank's
    index in it and its size."""

    group: Any
    rank: int
    size: int


def model_axis(mesh) -> Optional[ModelAxis]:
    """The model axis a tensor-parallel module needs, or None without a
    mesh or on a model axis of one rank (a data-parallel mesh keeps the
    plain modules: a sum over one rank would be a collective that does
    no work)."""
    if axis_size(mesh, AXIS_MODEL) == 1:
        return None
    return ModelAxis(axis_group(mesh, AXIS_MODEL), axis_rank(mesh, AXIS_MODEL),
                     axis_size(mesh, AXIS_MODEL))


# Inside `data_local()` the entry points act on the caller's rows only: a
# data group that already holds its share of the work (a scheduler's
# requests, a decode's rows) must not split and gather it again.
_DATA_LOCAL = contextvars.ContextVar("data_local", default=False)


@contextlib.contextmanager
def data_local():
    token = _DATA_LOCAL.set(True)
    try:
        yield
    finally:
        _DATA_LOCAL.reset(token)


def data_ways(mesh) -> int:
    """How many data ranks an entry point splits its batch over: the data
    axis, or 1 without a mesh or inside `data_local()`."""
    if mesh is None or _DATA_LOCAL.get():
        return 1
    return axis_size(mesh, AXIS_DATA)


def gather_objects(mesh, obj) -> List[Any]:
    """Every data rank's `obj`, in data-rank order, on every rank."""
    out: List[Any] = [None] * axis_size(mesh, AXIS_DATA)
    dist.all_gather_object(out, obj, group=axis_group(mesh, AXIS_DATA))
    return out


class _Raised(NamedTuple):
    """A data rank's share that raised: the exception, carried through the
    gather so that every rank raises it."""

    error: BaseException


def _picklable(e: Exception) -> Exception:
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


def split_over_data(mesh, n: int, fn: Callable[[int, int], list],
                    pad: bool = False) -> list:
    """Run `fn(lo, hi)` -> a list of hi - lo results on this data rank's
    contiguous share [lo, hi) of n items (inside `data_local()`), and
    return the n results in order on every rank. Shares hold ceil(n / d)
    items; with `pad` the last shares run past n (the caller repeats its
    last item there, as JAX pads a batch to the data axis) and the extra
    results are dropped, else they are cut short, possibly empty. A share
    that raises still joins the gather, and then every rank raises its
    exception (the first in data-rank order): the ranks stay in step."""
    d = data_ways(mesh)
    if d == 1:
        return fn(0, n)
    per = -(-n // d)
    r = axis_rank(mesh, AXIS_DATA)
    lo, hi = r * per, (r + 1) * per
    if not pad:
        lo, hi = min(lo, n), min(hi, n)
    with data_local():
        try:
            part = fn(lo, hi) if hi > lo else []
        except Exception as e:
            part = _Raised(_picklable(e))
    parts = gather_objects(mesh, part)
    for p in parts:
        if isinstance(p, _Raised):
            raise p.error
    return [x for p in parts for x in p][:n]
