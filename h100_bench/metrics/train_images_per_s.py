"""train_images_per_s: the images of every step the window completed over
the window's whole time, the card synchronised at both ends."""


def read(ctx):
    return ctx["images"] / ctx["seconds"]
