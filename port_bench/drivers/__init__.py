"""The general generators, one a path of the program. A traffic file
names its generator under ``driver``; the rest of the file is its
parameters.

Each module defines ``Cell(spec, seed, device, fault=None)``: set-up in
the constructor (inputs and weights from the seed, the program's objects
built, every shape the traffic uses warmed), then ``issue(i)`` (the
entry into the program that the window times), ``after(i)``,
``launches()``, ``zero_launches()``, ``trace_context(window, trace,
peaks)`` (``traced`` is set before the window of a traced run),
``release()`` and ``check(control=False)``, and ``FAULTS``, the faults
of the timed path that the cell can have.
"""
