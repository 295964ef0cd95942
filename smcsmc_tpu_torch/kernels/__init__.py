"""Tree primitives, site likelihood and the recombination-trip kernel."""
