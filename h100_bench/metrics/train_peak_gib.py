"""train_peak_gib: the card's peak of allocated memory over the window,
after a reset at its start, in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30
