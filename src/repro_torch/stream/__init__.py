"""repro_torch.stream — always-on streaming KWS (paper §III deployed shape).

Turns the offline KWT + quantised LUT stack into a streaming detector:

  features.py   streaming log-mel/MFCC frontend (framing -> FFT -> mel
                filterbank -> DCT) with a hop-at-a-time incremental API
  ring.py       externalized ring-buffer state (dicts of tensors): pure
                (state, frames) -> state
  engine.py     incremental KWT inference, bit-identical to the offline
                ``models.kwt.forward`` on the same window
  detector.py   posterior smoothing + hysteresis/refractory triggering

State lives in dicts of tensors, never in Python objects, so a serving
slot's state can be saved, moved and restored like any other tensor.
"""
