"""Seconds of air the window consumed per second of wall: the samples of
all completed calls or pushes over the sample rate, over the wall from the
window's start to the end of the last of them (ended by a synchronize).
1.0 is the line a live user needs."""


def read(rec):
    w = rec["window"]
    return w["air_s"] / w["wall_s"]
