"""The benchmark's own code: the generator, the profiler sessions, the
checks of the outputs, the peaks of the card and the cell lookup."""
