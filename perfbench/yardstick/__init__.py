"""The frozen yardstick: traffic, FLOP and byte counts, peaks, weights
drawn from the seed, the trace reader and the comparison.  It imports
nothing of the program."""
