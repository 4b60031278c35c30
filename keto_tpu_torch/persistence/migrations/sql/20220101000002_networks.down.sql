DROP TABLE keto_networks;
