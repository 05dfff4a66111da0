"""Plain PyTorch references, one a configuration: ``reference/<config>.py``."""
