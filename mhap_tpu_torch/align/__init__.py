"""Host DP alignment over AlignElements and windowed 1-bit sub-sketches
(the reference's abandoned third stage)."""
