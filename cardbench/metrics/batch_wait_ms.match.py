"""Mean ``batch.wait`` span (submit to the scheduler taking the request's
batch) over the traces ``Service.trace_log()`` holds at the profiled
slice's end."""


def read(m):
    waits = m.get("slice", {}).get("batch_wait_ms")
    return sum(waits) / len(waits) if waits else None
