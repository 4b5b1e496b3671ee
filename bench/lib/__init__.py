"""The harness's shared parts: finding a cell's files, traffic, work
counts, and the device trace."""
