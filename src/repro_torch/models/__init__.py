"""The language model: layers and the dense transformer."""
