"""repro_torch.launch — entry points of the port."""
