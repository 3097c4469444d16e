"""The stream's scenes, one module each, found by a configuration's
`stream.scene` (`benchmark/harness/stream.py`); a name that holds a dot
is a whole module name. A scene module gives

    make(layout_seed, n_objects, frames) -> synthetic.Scene
        the scene's geometry and its texture pool (the seed of a run
        deals the textures out afterwards); `frames`, the stream's
        length, for a scene whose extent follows it
    TRAJECTORIES: {name: trajectory(n_frames) -> Tcw [n, 7] float32}
        the trajectories it supports, by `stream.trajectory`

A new scene, or a scene with another trajectory, is a new module here.
"""
