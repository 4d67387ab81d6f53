"""``prep_s``: per solve of the window, the harness's synchronised wall
clock around the call minus the solve's own ``CPAPRResult.seconds``
(which starts at its first sweep): the entry's validation, mode sorts,
policies and layouts.  The mean over the window's solves."""


def read(run):
    preps = [s["wall_s"] - s["program_s"] for s in run.solves
             if "program_s" in s]
    return sum(preps) / len(preps) if preps else None
