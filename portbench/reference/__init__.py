"""The plain references that decide `correct`: float32 PyTorch, nothing of
the port, nothing the port made."""
