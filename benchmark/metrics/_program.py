"""The program's own tracer (`insite_tpu_torch.utils.profiling`): its
spans and counters record exactly while a profiler records, so their
totals after a traced run are the profiled slice's, read here a task of
the slice at a time. Nothing where the program has no tracer (a checkout
from before it), or where the span or counter did not run."""


def totals() -> dict:
    """The tracer's totals, or {} where the program has none."""
    try:
        from insite_tpu_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, 'totals', None)
    return read() if read is not None else {}


def per_task(trace, value):
    tasks = trace['slice'].get('tasks')
    if value is None or not tasks:
        return None
    return value / tasks


def span_ms(trace, name: str, field: str):
    """Milliseconds a task of span ``name``'s ``field`` ('host_s',
    'self_s' or 'device_s')."""
    entry = totals().get(name)
    if not isinstance(entry, dict) or entry.get(field) is None:
        return None
    return per_task(trace, 1e3 * entry[field])


def counter(trace, *names):
    """The sum of the counters ``names`` a task; nothing where none of
    them counted."""
    t = totals()
    found = [t[n] for n in names if isinstance(t.get(n), (int, float))]
    return per_task(trace, sum(found)) if found else None
