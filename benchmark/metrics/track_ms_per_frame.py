"""Tracking's host ms a frame (`tracking.track`: `track_frame`, the
motion-model and local-map searches, the two pose solves on K1, the
keyframe decision), from the port's own spans in the traced run's chunks
after its traced span (`benchmark/harness/spans.py`)."""

from benchmark.harness import spans


def read(run: dict):
    return spans.stage_ms(run, "tracking.track")
