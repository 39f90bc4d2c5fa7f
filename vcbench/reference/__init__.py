"""The plain reference the benchmark holds the program to: plain PyTorch,
float32 with TF32 off, no kernels, no cache, no batching across requests.
It imports nothing of the program and takes nothing the program made."""
