"""Copies of host data to the device per Newton iteration, over the traced
segment: the program's ``h2d_copies`` counter's increase over its
``newton.iter`` spans (portbench/spans.py); layer: Newton/CG control. None
where the program has no such counter or took no Newton iteration."""

from portbench import spans


def read(trace):
    prog = spans.program(trace)
    if prog is None:
        return None
    newton = len(spans.named(prog, "newton.iter"))
    return prog["counts"].get("h2d_copies", 0) / newton if newton else None
