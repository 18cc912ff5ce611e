"""Solution plots (matplotlib, imported by ``VarNet.sim_res`` on demand)."""
