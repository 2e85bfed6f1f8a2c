"""Process model, knobs and core types of the PyTorch port."""
