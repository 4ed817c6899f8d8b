"""The faults planted under a cell's timed path. Each takes the test's
`monkeypatch` and the cell (`spec.Cell`); a run with any of them in place
has to read not correct. The cells run on one card, so no exchange
between cards can be left out."""
from __future__ import annotations


def state_unchanged(monkeypatch, cell):
    """Every product returns its input."""
    from graphlily_tpu_torch.module import SpMSpVModule, SpMVModule
    monkeypatch.setattr(SpMVModule, "apply", lambda self, x, mask=None: x)
    monkeypatch.setattr(SpMSpVModule, "apply_dense",
                        lambda self, x, mask=None: x)


def half_the_rows(monkeypatch, cell):
    """Each product leaves out its second half of rows (the semiring's
    zero there)."""
    from graphlily_tpu_torch.module import SpMSpVModule, SpMVModule
    for cls, meth in ((SpMVModule, "apply"), (SpMSpVModule, "apply_dense")):
        orig = getattr(cls, meth)

        def half(self, x, mask=None, _orig=orig):
            y = _orig(self, x, mask).clone()
            y[y.shape[0] // 2:] = self.semiring_.zero
            return y
        monkeypatch.setattr(cls, meth, half)


def answer_altered(monkeypatch, cell):
    """The answer altered where the app produces it: the traffic's
    `alter` on what its `ENTRY` returns."""
    cls, meth = cell.entry.ENTRY
    orig = getattr(cls, meth)

    def altered(self, *a, **k):
        return cell.entry.alter(orig(self, *a, **k))
    monkeypatch.setattr(cls, meth, altered)


FAULTS = {"state_unchanged": state_unchanged,
          "half_the_rows": half_the_rows,
          "answer_altered": answer_altered}
