"""The Engine (serving and training steps), its optimizer and the losses."""
