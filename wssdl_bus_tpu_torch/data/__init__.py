"""Host-side image preparation, training augmentation and minibatches."""
