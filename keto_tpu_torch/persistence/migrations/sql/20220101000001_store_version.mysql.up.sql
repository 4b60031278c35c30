-- MySQL overlay: VARCHAR primary key (indexed TEXT needs prefix lengths).
CREATE TABLE keto_store_version (
    nid VARCHAR(64) PRIMARY KEY,
    version BIGINT NOT NULL
);
