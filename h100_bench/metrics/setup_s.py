"""setup_s: from the process's start to the window's (imports, the
database, the model and its weights, kernel builds, the first steps)."""


def read(ctx):
    return ctx["setup_s"]
