"""setup_s: from the start of the process to the start of the window:
imports, building or loading the kernels, making the data and weights,
building the program's object and its first steps (which compile and
warm up every shape the window uses)."""


def read(ctx):
    return ctx.setup_s
