"""Scoring (the port of ``datatunerx_tpu/scoring``): the text metrics
(``metrics``), the built-in probe scorer (``builtin``), the dataset-driven
scorer (``dataset_scoring``), scoring plugins (``plugin``) and the Scoring
CR's controller (``controller``), which the controller-manager registers.
"""
