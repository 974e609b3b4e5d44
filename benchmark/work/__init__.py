"""Operation and byte counts of each model's work, one module per model
(named by a configuration's ``model``), computed from its shapes."""
