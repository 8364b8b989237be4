"""Matrices brought to the requested form (factored, reduced, solved or
multiplied) in the window, over the window's seconds on the host clock:
all the work over all the time, each call ended by a synchronize."""

from portbench.timeline import rate


def read(rec):
    return rate(rec.matrices, rec.window_s)
