"""Dataset generators and readers (the port's own copies)."""
