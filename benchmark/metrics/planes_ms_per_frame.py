"""Plane segmentation's host ms a frame (`frontend.planes`:
`ops/planes.segment_planes`), from the port's own spans in the traced
run's chunks after its traced span (`benchmark/harness/spans.py`)."""

from benchmark.harness import spans


def read(run: dict):
    return spans.stage_ms(run, "frontend.planes")
