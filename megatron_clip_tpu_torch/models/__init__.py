"""Model towers."""
