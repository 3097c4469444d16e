"""Keyframes inserted in the window (`diag["kf_inserted"]` of
`slam_chunk`, which the System records) per 100 frames: the keyframe
branch's work count. A program that speeds up by inserting fewer
keyframes shows here."""


def read(run: dict):
    if not run.get("frames"):
        return None
    return 100.0 * run["kf_inserted"] / run["frames"]
