"""setup_s (s, host clock): from the process's start to the end of the
warm-up family: imports, CUDA context, the kernels from their build
cache, the warm-up."""


def read(ctx):
    return ctx.setup_s
