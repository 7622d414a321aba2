"""The differentiable render pipeline."""
