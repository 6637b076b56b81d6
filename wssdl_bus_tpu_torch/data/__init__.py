"""Host-side image preparation."""
