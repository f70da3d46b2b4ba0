"""Device ops: the fused PointNet kernel, decode and preprocessing."""
