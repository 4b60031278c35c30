DROP TABLE keto_store_version;
