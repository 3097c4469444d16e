"""The device's idle share of the traced span: 1 - (the union of its
activity intervals in the CUPTI trace / the span's length by the host's
clock between two synchronisations)."""


def read(run: dict):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
