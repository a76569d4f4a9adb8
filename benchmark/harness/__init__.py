"""The harness: file discovery, weights and inputs from the seed, the device
trace, and the result line."""
