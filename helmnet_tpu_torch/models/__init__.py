"""The learned network: activations, conv blocks and HybridNet."""
