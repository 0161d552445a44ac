"""Layers, feature pyramid and heads of the faithful DecNet."""
