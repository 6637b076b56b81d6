"""The inference Engine (training steps arrive with the training slice)."""
