"""Requests over batches at the HTTP front end for the whole window: the
differences of the server's own `requests_total` and `batches_total`
counters (`utils/obs.Metrics`) between the window's open and its close."""


def read(rec):
    batches = rec.window_counters.get("batches_total", 0)
    if batches <= 0:
        return None
    return rec.window_counters.get("requests_total", 0) / batches
