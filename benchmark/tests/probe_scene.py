"""A scene that the harness never names (`benchmark/gen/scenes/` holds no
such module): the room with a trajectory of its own, the tour run
backwards. The tests point a configuration at it by its whole module
name."""

from benchmark.gen.scenes import room

make = room.make


def tour_backwards(n_frames: int):
    return room.tour(n_frames)[::-1].copy()


TRAJECTORIES = {"tour_backwards": tour_backwards}
