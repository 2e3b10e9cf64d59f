"""The decoder-only TransformerLM (training and inference), its converter and generation."""
