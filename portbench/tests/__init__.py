"""The benchmark's own tests (CPU; the card-marked ones skip without CUDA)."""
