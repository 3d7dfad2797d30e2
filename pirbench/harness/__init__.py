"""The benchmark's harness: cells, traffic, the service under test, the load
processes, the trace and the work counts behind the rooflines."""
