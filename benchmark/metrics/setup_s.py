"""setup_s: from the start of the process's Python code to the first timed
call: imports, the kernel library's load (and its first build), the staged
inputs and the warm-up calls (host clock)."""


def read(ctx):
    return ctx.setup_s
