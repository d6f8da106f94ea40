"""Distribution of the port: logical-axis sharding rules and layouts
(``sharding``), the activation-sharding context the models annotate
(``api``), gradient compression (``compression``) and the train-step
sharding problem kind (``tuning``)."""
