"""The runnable examples on the port, one module each:

  python -m densephrases_tpu_torch.examples.<name> [--cpu] [--load_dir DIR]

``create_custom_index`` indexes a user's ``--articles`` file and answers
its ``--questions``; ``entity_linking``, ``slot_filling``,
``knowledge_dialogue`` and ``fid_reader`` run the KILT-shaped tasks over
``_common.TINY_WIKI``. The counterparts of ``examples/*/run.py``, which
drive the JAX package. They run on the card unless ``--cpu`` is given.
"""
