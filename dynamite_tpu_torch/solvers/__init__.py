"""Krylov solvers: Lanczos eigensolving and expmv time evolution."""
