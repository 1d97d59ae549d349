"""One module per kind of timed entry, named by a mix file's ``entry``.

Each module holds the three parts of its kind: the build through the
program's public entries and the timed call, the window
(``run(cfg, mix, seed, seconds, trace, device, t0, names)``, which
returns the run's end-to-end values, counters, traced segment, peak and
compared numbers), and the judge against the plain reference, with
``calibrate(cfg, mix, control, device, emit)`` for the readings that
limits are set from.  A new kind of model or loop is a new module here.
"""
