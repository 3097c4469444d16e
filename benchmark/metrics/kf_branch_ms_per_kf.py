"""The keyframe branch's host ms a keyframe (`mapping.kf_branch`, on the
frames that insert one: insertion, point creation, the plane map, local
mapping with local BA, the object merge), from the port's own spans in
the traced run's chunks after its traced span
(`benchmark/harness/spans.py`)."""

from benchmark.harness import spans


def read(run: dict):
    return spans.stage_ms(run, "mapping.kf_branch", per="span")
