"""Weight conversion, BatchNorm folding and device choice."""
