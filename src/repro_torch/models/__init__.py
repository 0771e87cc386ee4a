"""Dense transformer on PyTorch: layers, attention, blocks, model API."""
