"""The plain reference: the model's forward in float32 PyTorch, with no
kernel, cache or batching of the program."""
