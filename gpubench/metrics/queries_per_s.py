"""queries_per_s: queries of every stream that completed inside the
window with the reference's rows, over the window's seconds."""


def read(ctx):
    done = sum(1 for r in ctx.records
               if r["ok"] and r["done"] <= ctx.window_end)
    return done / ctx.window_s
