"""The decoder-only TransformerLM (inference), its converter and generation."""
