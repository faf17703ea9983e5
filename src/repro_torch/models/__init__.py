"""The LM substrate's models: configuration, shared components, attention
and the assembled dense attention family (``g`` and ``l`` blocks)."""
