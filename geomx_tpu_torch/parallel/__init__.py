"""Attention building blocks of the flagship transformer (single
device so far; the ring over an ``sp`` mesh axis comes with the
multi-device slice)."""
