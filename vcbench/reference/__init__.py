"""The plain references the benchmark holds the program to: plain PyTorch,
float32 with TF32 off, no kernels, no cache, no batching across requests.
They import nothing of the program and take nothing the program made.
Each configuration names its module (``model.py``, the dense decoder,
where it names none; ``model.py`` states the contract); ``common.py``
holds what every architecture shares."""
