"""Mel constants (counterpart of ``waveglow_tpu/dsp/mel.py``; the mel
front end itself belongs to training and is not ported yet)."""

# Log-clamp floor of the mel front end: log(CLIP_VAL) is the silence level
# that bucket padding fills with.
CLIP_VAL = 1e-5
