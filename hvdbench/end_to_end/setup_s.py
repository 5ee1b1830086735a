"""Set-up: from the start of the process that runs the cell (the launcher's,
on several ranks) to the first timed step: import, init, weights, kernel
builds and loads, warm-up, capture and the first steps that the comparison
reads."""


def read(ctx):
    return ctx["setup_s"]
