"""Device compute: MSC representation, complex plane arithmetic, subspace
index maps, and the matrix-free Pauli-string matvec with its CUDA kernel."""
