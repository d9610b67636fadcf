"""Traffic generators, each named by the traffic files that use it."""
