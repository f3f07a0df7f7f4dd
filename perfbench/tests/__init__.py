"""CPU tests of the benchmark (and a few that need the card)."""
