"""Device events (kernels, copies, sets) in the traced span over its
frames: the count the port's eager host dispatch pays for, launch by
launch."""


def read(run: dict):
    trace = run.get("trace")
    if not trace or not run.get("trace_frames"):
        return None
    return trace["n_events"] / run["trace_frames"]
