"""setup_s: seconds from the process's start to the window's first query
(imports, the card, the kernel's build or load, the tables, the warm-up)."""


def read(ctx):
    return ctx.setup_s
