"""The port's tools: the text-generation server, its client and the bulk
sampler, the corpus preprocessor, and measurement scripts (which need a
CUDA device)."""
