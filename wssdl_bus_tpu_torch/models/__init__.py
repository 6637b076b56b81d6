"""VGG16 detector modules and the weight bridge from the JAX package."""
