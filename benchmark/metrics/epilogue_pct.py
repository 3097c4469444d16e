"""The chunk boundary's share of the window (`System.chunk_epilogue`:
loop detection harvest and dispatch, GBA merge, compaction, eviction,
relocalization): the host-clock seconds of the epilogues, each
synchronised before and after, over the seconds of the same chunks and
epilogues, in the traced run's chunks after its traced span."""


def read(run: dict):
    if not run.get("untraced_s"):
        return None
    return 100.0 * run["epilogue_s"] / run["untraced_s"]
