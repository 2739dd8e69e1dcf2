"""repro_torch.core — the interface layer of the port: typed errors, the
MPI_T-style pvar/cvar registry, sessions and groups, the single-process
communicator and persistent requests."""
