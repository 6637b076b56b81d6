"""Detection (serving) pipeline."""
