"""stem_device_ms.train: device milliseconds a traced step of the
operations launched under the port's ``wssdl::stem`` span (VGG16's
conv1-conv2 with pool1-2, frozen; ``hbench/program_trace.py`` gives a
launch to the innermost span open when it was made), the mean over the
traced steps.  Nothing where the trace holds no such span."""


def read(ctx):
    pt = ctx.get("program_trace")
    if pt is None:
        return None
    steps = pt.parts()["steps"]
    stem = [s["stem"]["device_ms"] for s in steps if "stem" in s]
    return sum(stem) / len(steps) if stem else None
