"""Inference engine (sliding-window sweep) and evaluation of the port."""
