"""Rounds completed in the window x 60 / the window's seconds (host clock).
The window closes when the last round it started has its metrics on the
host."""


def read(ctx):
    return len(ctx.round_s) * 60.0 / ctx.window_s
