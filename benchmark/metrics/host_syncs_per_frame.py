"""Device -> host synchronisations a frame inside `steady.slam_chunk`
(`.item()`, `.tolist()`, `int()` of a tensor, mask indexing and
`nonzero`, blocking copies): the port's `host_sync` counter over every
span of the traced run's chunks after its traced span
(`benchmark/harness/spans.py`). Each one stalls the host until the card
has drained its queue."""

from benchmark.harness import spans


def read(run: dict):
    return spans.syncs_per_frame(run)
