"""data_build_s: the host data build, timed by the harness around VarNet(...) (the mesh,
quadrature tables and coefficient fields of fem/assembly.py, and their copy to the card)."""


def read(ctx):
    return ctx.spans.get("data_build_s")
