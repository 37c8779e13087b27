"""Faults planted underneath the timed path, for the tests and for
``readings.py --faults``: each breaks the served answers in a way a
serving cell can fail, and the check must come out not correct.

- ``half_the_batch``: a batch's second half gets the answers of its first
  half;
- ``altered_answer``: each query's best answer has its span moved by one
  word where ``MIPS._assemble`` makes it.

A step that returns its state unchanged and the exchange between chips
belong to training and to cells on several chips; no cell has them.
"""


def half_the_batch(served):
    serve = served.serve

    def broken(texts):
        half = max(len(texts) // 2, 1)
        out = serve(texts[:half])
        return [out[i % half] for i in range(len(texts))]

    served.serve = broken


def altered_answer(served):
    mips = served.model.mips
    assemble = mips._assemble

    def broken(*args, **kwargs):
        outs = assemble(*args, **kwargs)
        for cands in outs:
            if cands:
                r = cands[0]
                step = 5 if r["end_pos"] + 5 < len(r["context"]) else -5
                if r["end_pos"] + step > r["start_pos"]:
                    r["end_pos"] += step
                else:
                    r["start_pos"] -= 5
                r["answer"] = r["context"][r["start_pos"]:r["end_pos"]]
        return outs

    mips._assemble = broken


FAULTS = {"half_the_batch": half_the_batch, "altered_answer": altered_answer}
