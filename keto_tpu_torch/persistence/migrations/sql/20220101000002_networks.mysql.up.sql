-- MySQL overlay: VARCHAR primary key, DOUBLE timestamp.
CREATE TABLE keto_networks (
    id VARCHAR(64) PRIMARY KEY,
    created_at DOUBLE NOT NULL
);
