"""The object lane's host ms a frame (`objects.lane`: the frame objects,
their merge with the last frame's, the ensemble association and the
object update), from the port's own spans in the traced run's chunks
after its traced span (`benchmark/harness/spans.py`)."""

from benchmark.harness import spans


def read(run: dict):
    return spans.stage_ms(run, "objects.lane")
