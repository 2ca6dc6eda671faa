"""The plain reference: a frozen HGum request/response codec, the weights
made from the seed, and a float32 forward of the dense-GQA and top-k
capacity-MoE decoder.  Imports torch and numpy only: nothing of the
program and nothing of JAX."""
