"""The kinds of call that `correct` captures in the window and compares
with the plain reference (`benchmark/reference/`), one module each,
found by the names of a workload file's `capture`
(`benchmark/harness/check.py`); a name that holds a dot is a whole
module name. A kind module declares

    TARGET = (module, function)
        the program's function that it wraps while the window runs
    NUMBERS = (name, ...)
        the numbers it yields, each compared against the cell's limit
    wrap(orig, take, keep) -> function
        the wrapper of `orig`: `take()` says whether this call is one
        that the seed drew, and `keep(item)` keeps what the wrapper
        copied of it (the inputs, and the answer under "out")
    numbers(items) -> {name: value or None}
        every name of NUMBERS, worked out against the reference over the
        kept items once the window has closed; None where no call was
        drawn
    control(item) -> the answer in the program's form
        the control's: the reference computed in the nearest precision
        below (bfloat16), which `benchmark/tools/readings.py` puts in
        the program's place

A new kind is a new module here; modules whose names start with `_` are
not kinds.
"""
