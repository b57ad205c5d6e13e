"""A run with the timed path broken underneath reads ``correct`` false:
for each fault a cell can have (one card: no exchange between chips to
leave out), at a tiny size on the CPU, past the harness's look for a
card.  And the control: the configuration's next lower precision in the
program's place reads false too."""

import pytest
import torch

from bench.tests import tiny


def _kind(spec, cell):
    return spec.traffic(spec.workload(cell)["kind"])


def half_batch(base):
    """Half of each call's batch left out: the first half's answers stand
    for the second's."""
    class Cell(base):
        def setup(self):
            super().setup()
            fwd = self.engine.forward

            def forward(x):
                h = max(1, x.shape[0] // 2)
                y = fwd(x[:h])
                return torch.cat([y, y])[:x.shape[0]]
            self.engine.forward = forward
    return Cell


def altered_answer(base):
    """One answer of every call altered where it is produced: the first
    window's first logit, or the logit of the first sequence's second
    token."""
    class Cell(base):
        def setup(self):
            super().setup()
            fwd = self.engine.forward

            def forward(x):
                y = fwd(x).clone()
                if y.ndim == 3:
                    y[0, 0, int(x[0, 1])] += 1.0
                else:
                    y[0, 0] += 1.0
                return y
            self.engine.forward = forward
    return Cell


def frozen_state(base):
    """A hop that returns the lanes' state unchanged."""
    class Cell(base):
        def setup(self):
            super().setup()
            lanes = self.lanes
            encode = lanes._encode_step

            def step(p, chunk):
                before = lanes.state
                out = encode(p, chunk)
                lanes.state = before
                return out
            lanes._encode_step = step
    return Cell


def altered_score(base):
    """One lane's reported score altered at every hop."""
    class Cell(base):
        def setup(self):
            super().setup()
            hop = self.lanes.hop

            def altered(chunk, ingest=None):
                ev = hop(chunk, ingest)
                ev["score"] = ev["score"].copy()
                ev["score"][0] += 0.5
                return ev
            self.lanes.hop = altered
    return Cell


def altered_event(base):
    """One lane's event altered at every hop: a fire where the detector
    has none, or none where it has one."""
    class Cell(base):
        def setup(self):
            super().setup()
            hop = self.lanes.hop

            def altered(chunk, ingest=None):
                ev = hop(chunk, ingest)
                ev["fired"] = ev["fired"].copy()
                ev["fired"][0] = ~ev["fired"][0]
                return ev
            self.lanes.hop = altered
    return Cell


FAULTS = [("kwt1.bulk", half_batch), ("kwt1.bulk", altered_answer),
          ("kwt1.streams", frozen_state), ("kwt1.streams", altered_score),
          ("kwt1.streams", altered_event),
          ("internlm2.score_1k", half_batch),
          ("internlm2.score_8k", altered_answer),
          ("internlm2.score_1k", altered_answer)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(spec, cell, fault):
    sound = tiny.run(spec, cell)
    assert sound["correct"], sound["checks"]
    broken = tiny.run(spec, cell, cell_class=fault(_kind(spec, cell).Cell))
    assert not broken["correct"], broken["checks"]


CONTROLS = [(cell, name) for cell in sorted(tiny.CASES)
            for name in ("tf32", "int4")]


@pytest.mark.parametrize("cell,control", CONTROLS,
                         ids=[f"{c}-{n}" for c, n in CONTROLS])
def test_the_controls_are_not_correct(spec, cell, control):
    """Each control of the workload file in the program's place: the int4
    path (``plan``), or the program's own TF32 switched on after set-up
    (the configurations state float32 products with TF32 off), which
    reads ``tf32`` 1; the reference runs with TF32 off all the same."""
    from bench.core import precision
    wl = spec.workload(cell)
    assert wl["control"] == "tf32"
    ctl = wl["controls"][control]
    switch = (lambda: precision.allow_tf32(True)) if ctl.get("tf32") \
        else None
    try:
        res = tiny.run(spec, cell, plan=ctl.get("plan"), after_setup=switch)
        assert not precision.tf32_allowed()
    finally:
        precision.allow_tf32(False)
    assert not res["correct"], res["checks"]
    tf32 = [c["value"] for c in res["checks"] if c["name"] == "tf32"]
    assert tf32 == [1.0 if ctl.get("tf32") else 0.0]
