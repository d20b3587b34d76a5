"""Fleet sharding over devices and the weak-scaling harness."""
