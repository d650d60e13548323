"""Configuration, activations and initializers."""
