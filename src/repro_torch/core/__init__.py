"""GQSA compression: quantization, group pruning, BSR packing, GQS layer."""
