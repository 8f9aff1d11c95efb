"""Pre-defined sparse patterns (numpy; the port's own copies) and the
int8 quantization of junction slabs."""
