"""The benchmark's input generators, one module per kind of traffic.

A cell's file (``portbench/cells/<cell>.json``) names its generator under
``"generator"``; the harness imports ``portbench.generators.<name>`` and
calls ``make(traffic, config, seed, device)``.  A generator makes every
input from the seed, hands the program the pieces its users' path builds,
and hands the reference the same raw inputs (never what the program
derived from them).  It returns a dict:

  model, data, params, cfg, estate   the program's pieces (this rank's rows)
  reconstruct_at                     EMTrainer's argument, or None
  make_callback(dlog)                the app's epoch callback, or None
  merge_every                        epochs between merges, or None
  init_seed                          the seed of Theta^0 and K^0
  ref                                the reference's inputs: {Y [N, D] (NaN
                                     where missing), image} with the image
                                     dict {task, clean, corrupted, patch} or None
"""
