"""Model-level code of the port: the LM template (``config``, ``layers``,
``model``; dense families) and the NDPP samplers' row sharding
(``sharding``)."""
