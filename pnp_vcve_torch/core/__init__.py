"""Configs, registry, presets, builder, checkpoint I/O and weight conversion."""
