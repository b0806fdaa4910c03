"""The benchmark's shared code: run set-up, the cell files, seeded weights
and traffic, the arithmetic of rates and tails, work counts against the
H100's published peaks, and the reading of a profiler window."""
