"""Process start to window start: imports, the card's start-up, the
weights made from the seed, building or loading the program's CUDA
kernels, and the warm-up call of the cell's shapes."""
UNIT = "s"


def read(run):
    return run.setup_s
